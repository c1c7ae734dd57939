"""K9: a ConvNeXt block's 7x7 depthwise convolution, its bias and the
LayerNorm that follows, one NHWC CUDA kernel (``csrc/dw_ln.cu``), and its
plain PyTorch version.

``depthwise7_ln(x, w_dw, b_dw, ln_w, ln_b)`` is ``LN(dwconv7x7(x) + b_dw) *
ln_w + ln_b`` over the last axis (zero padding 3, stride 1, float32
statistics), the ``conv_dw`` -> ``norm`` half of ``models/convnext.py
ConvNeXtBlock``. The taps and the bias are rounded to the compute dtype, as
the layers round their parameters at use, and summed in float32; the
statistics come from those float32 sums and each output is rounded once.
The JAX package runs this on XLA's convolution, with no Pallas kernel, so
K9 replaces no TPU kernel. On the card the op is below the ridge (T read
and written once, 49 float32 FMAs an element on the CUDA cores); the
kernel keeps a tile's conv results in shared memory for its LayerNorm, so
nothing returns to device memory between the two. ``dw_ln_plan`` cuts the
work (tile, channel chunk, resident and persistent blocks); ``dw_ln_taps``
lays the taps out as the kernel stages them, once a weight;
``dw_ln_info`` reports the kernel's resources.

Differentiable: the backward recomputes through the plain version from the
saved inputs (as K1's and K3's default backward do).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp
from flair_for_aigle_tpu_torch.ops.mma_plan import n_sm
from flair_for_aigle_tpu_torch.utils import profiling

#: threads of a kernel block
DW_THREADS = 256
#: output rows of a thread's strip (``csrc/dw_ln.cu DW_ROWS``)
DW_ROWS = 4
#: resident blocks per SM the kernel's launch bounds promise
DW_MIN_BLOCKS = 2
#: the tiles the plan picks from, (columns, rows): columns a power of two
#: (lanes take neighbouring columns), rows a power of two times DW_ROWS
DW_TILES = ((4, 4), (8, 4), (8, 8), (16, 8), (16, 16))
#: dynamic shared memory a block may take, and an SM's shared memory of
#: which each resident block reserves 1 KB (the H100's)
SMEM_BLOCK = 227 * 1024
SMEM_SM = 228 * 1024
#: the plan's cost model, in SM clock cycles: an output element's 49 FMAs
#: with their shared-memory reads and bf16 conversions, at all of an SM's
#: threads; and a staged byte, from L2, which a second resident block hides
CYCLES_PER_ELEMENT = 0.56
CYCLES_PER_STAGED_BYTE = 1 / 24
#: the share of the staging that other resident blocks leave in the way
STAGED_SHOWN = 0.25


class DwLnPlan(NamedTuple):
    """How ``csrc/dw_ln.cu`` cuts one call: tiles of ``tw`` x ``th`` output
    pixels (``tiles_x`` x ``tiles_y`` an image), the channels in chunks of
    ``cc``, ``smem`` dynamic shared bytes a block, of which an SM holds
    ``resident``; ``blocks`` persistent blocks (one wave of resident
    blocks, at most one a tile)."""
    tw: int
    th: int
    cc: int
    smem: int
    resident: int
    tiles_x: int
    tiles_y: int
    blocks: int


def _esize(dtype) -> int:
    return {torch.bfloat16: 2, torch.float32: 4}[dtype]


def dw_ln_smem(tw: int, th: int, cc: int, c: int, dtype) -> int:
    """Dynamic shared bytes of a block (``csrc/dw_ln.cu dw_smem_bytes``):
    two buffers, each a chunk's halo in the compute dtype (a channel
    vector's pixels padded by one) and its 49 taps in float32, and the
    tile's results over all C in float32 (a pixel's row padded by 4)."""
    hp1 = (th + 6) * (tw + 6) + 1
    return 2 * (cc // 8) * (hp1 * 8 * _esize(dtype) + 49 * 8 * 4) + th * tw * (c + 4) * 4


def _check_channels(c: int) -> None:
    if c <= 0 or c % 8:
        raise ValueError(f"depthwise7_ln: C={c} must be a positive multiple of 8 (a thread "
                         f"computes 8 neighbouring channels, one 16-byte vector of bf16)")


@functools.lru_cache(maxsize=256)
def dw_ln_plan(b: int, h: int, w: int, c: int, dtype, sms: int) -> DwLnPlan:
    """The plan of one call on (B, H, W, C) in ``dtype`` on a card of
    ``sms`` SMs. For each tile of ``DW_TILES``: the chunk that gives each of
    the block's threads one strip of 4 channels (at most C), halved until
    the block's shared memory fits; the resident blocks that memory allows
    (at most the launch bounds' 2), one wave of them persistent. The plan
    takes the tile of least estimated time: whole waves of resident blocks
    times each block's compute, which grows as threads sit idle, and its
    staging, a quarter of which shows where other resident blocks hide the
    rest. Raises ValueError where C is not a multiple of 8 or too wide for
    any tile. Cached: a model calls it with a few shapes."""
    _check_channels(c)
    best, best_cost = None, None
    for tw, th in DW_TILES:
        strips = tw * th // DW_ROWS
        cc = min(c, max(8, DW_THREADS // (2 * strips) * 8))
        while cc > 8 and dw_ln_smem(tw, th, cc, c, dtype) > SMEM_BLOCK:
            cc = max(8, cc // 16 * 8)
        smem = dw_ln_smem(tw, th, cc, c, dtype)
        if smem > SMEM_BLOCK:
            continue
        resident = min(DW_MIN_BLOCKS, SMEM_SM // (smem + 1024))
        tiles_x, tiles_y = -(-w // tw), -(-h // th)
        waves = -(-(b * tiles_x * tiles_y) // (sms * resident))
        busy = min(1.0, 2 * strips * (cc // 8) / DW_THREADS)
        staged = ((th + 6) * (tw + 6) * c * _esize(dtype) + 49 * c * 4) * CYCLES_PER_STAGED_BYTE
        cost = waves * resident * (tw * th * c * CYCLES_PER_ELEMENT / busy
                                   + staged * (1.0 if resident == 1 else STAGED_SHOWN))
        if best_cost is None or cost < best_cost:
            blocks = min(b * tiles_x * tiles_y, sms * resident)
            best = DwLnPlan(tw, th, cc, smem, resident, tiles_x, tiles_y, blocks)
            best_cost = cost
    if best is None:
        raise ValueError(f"depthwise7_ln: C={c} is too wide for the kernel's smallest tile")
    return best


def depthwise7_ln_reference(x: torch.Tensor, w_dw, b_dw, ln_w, ln_b, *,
                            eps: float = 1e-6) -> torch.Tensor:
    """Plain version: the taps and the bias rounded to x's dtype, the
    convolution and the LayerNorm (its statistics and affine) in float32,
    one rounding to x's dtype at the end."""
    c = x.shape[-1]
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w_dw.to(x.dtype).float(), None, 1, 3, 1, c)
    y = y.permute(0, 2, 3, 1) + b_dw.to(x.dtype).float()
    mean = y.mean(-1, keepdim=True)
    var = ((y - mean) ** 2).mean(-1, keepdim=True)
    out = (y - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    return out.to(x.dtype)


def dw_ln_taps(w_dw: torch.Tensor, dtype, device) -> torch.Tensor:
    """The taps of the (C, 1, 7, 7) depthwise weight as ``csrc/dw_ln.cu``
    stages them: (C / 8, 49, 8) float32 on ``device``, each rounded to
    ``dtype`` (as the layers round their parameters at use). Kept on the
    weight itself and made again only when the weight changes (its version
    counter: an optimizer step, a loaded state), so inference makes them
    once a weight and launches nothing else."""
    key = (dtype, str(device))
    try:
        key += (w_dw._version,)
    except RuntimeError:  # an inference tensor keeps no version: no cache
        key = None
    hit = getattr(w_dw, "_dw_ln_taps", None)
    if key is not None and hit is not None and hit[0] == key:
        return hit[1]
    c = w_dw.shape[0]
    with torch.no_grad():
        taps = _build.aligned(w_dw.detach().reshape(c // 8, 8, 49).transpose(1, 2)
                              .to(device=device, dtype=dtype).float().contiguous())
    if key is not None:
        w_dw._dw_ln_taps = (key, taps)
    return taps


def _launch(x: torch.Tensor, w_dw, b_dw, ln_w, ln_b, eps: float) -> torch.Tensor:
    """The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    _check_channels(x.shape[-1])
    if x.device.type == "cpu":
        return depthwise7_ln_reference(x, w_dw, b_dw, ln_w, ln_b, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise7_ln: unsupported device {x.device}")
    return _kernel(x, w_dw, b_dw, ln_w, ln_b, eps)


def _kernel(x: torch.Tensor, w_dw, b_dw, ln_w, ln_b, eps: float) -> torch.Tensor:
    """The kernel's launch: checks, plan, the output and nothing else
    allocated; parameters already in place pass through uncopied."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"depthwise7_ln: unsupported dtype {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"depthwise7_ln: x must be (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if tuple(w_dw.shape) != (c, 1, 7, 7):
        raise ValueError(f"depthwise7_ln: w_dw must be (C, 1, 7, 7), got {tuple(w_dw.shape)}")
    # the kernel reads x 16 bytes at a time, its parameters by 16-byte vectors
    x = _build.aligned(x.contiguous())
    taps = dw_ln_taps(w_dw, x.dtype, x.device)
    bd, g, bt = (_build.param(p, x.device, torch.float32) for p in (b_dw, ln_w, ln_b))
    if bd.numel() != c or g.numel() != c or bt.numel() != c:
        raise ValueError("depthwise7_ln: the conv bias and the LayerNorm parameters must "
                         "have C entries")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    plan = dw_ln_plan(b, h, w, c, x.dtype, n_sm(x.device))
    rc = _build.lib().dw_ln_fwd(
        x.data_ptr(), taps.data_ptr(), bd.data_ptr(), g.data_ptr(), bt.data_ptr(),
        out.data_ptr(), b, h, w, c, plan.tw.bit_length() - 1,
        (plan.th // DW_ROWS).bit_length() - 1, plan.cc, plan.blocks, eps,
        _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "dw_ln_fwd")
    depthwise7_ln.launches += 1
    profiling.count("dw_ln_launches")
    return out


class _DwLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_dw, b_dw, ln_w, ln_b, eps):
        ctx.save_for_backward(x, w_dw, b_dw, ln_w, ln_b)
        ctx.eps = eps
        return _launch(x, w_dw, b_dw, ln_w, ln_b, eps)

    @staticmethod
    def backward(ctx, g):
        grads = plain_vjp(lambda *a: depthwise7_ln_reference(*a, eps=ctx.eps),
                          ctx.saved_tensors, g, ctx.needs_input_grad[:5])
        return (*grads, None)


def depthwise7_ln(x: torch.Tensor, w_dw, b_dw, ln_w, ln_b, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C): ``LN(dwconv7x7(x) + b_dw) * ln_w +
    ln_b``, ``w_dw`` the (C, 1, 7, 7) depthwise weight. CPU tensors take the
    plain version; CUDA tensors launch the kernel (float32 or bfloat16; a
    non-contiguous x is copied first). Raises ValueError where C is not a
    multiple of 8. Differentiable in x and the four parameters; where no
    gradient is wanted (inference) it skips the autograd node."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w_dw, b_dw, ln_w, ln_b)):
        return _DwLn.apply(x, w_dw, b_dw, ln_w, ln_b, eps)
    return _launch(x, w_dw, b_dw, ln_w, ln_b, eps)


depthwise7_ln.launches = 0
#: the kernel's launches, a key of every zonal call's record
profiling.declare(dw_ln_launches=0)


def dw_ln_info(b: int, h: int, w: int, c: int, dtype=torch.bfloat16) -> dict:
    """The resources of the kernel that ``depthwise7_ln`` runs on (B, H, W,
    C) in ``dtype`` on the current card, as the CUDA runtime reports them:
    registers per thread, local (spill) bytes per thread, shared bytes per
    block and resident blocks per SM; with the plan it runs and the blocks
    per SM that plan promises."""
    plan = dw_ln_plan(b, h, w, c, dtype, n_sm(torch.device("cuda", torch.cuda.current_device())))
    out = (ctypes.c_int * 4)()
    rc = _build.lib().dw_ln_info(0 if dtype == torch.float32 else 1, plan.tw.bit_length() - 1,
                                 (plan.th // DW_ROWS).bit_length() - 1, plan.cc, c,
                                 ctypes.addressof(out))
    _build.check(rc, "dw_ln_info")
    return {**dict(zip(("regs", "spill_bytes", "shared_bytes", "blocks_per_sm"), out)),
            **plan._asdict()}
