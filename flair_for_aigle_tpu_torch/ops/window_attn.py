"""K2: fused swin window attention forward (CUDA kernel
``csrc/window_attn.cu``) and K6, its backward (``csrc/window_attn_bwd.cu``),
with their plain PyTorch versions.

Replaces ``flair_for_aigle_tpu/ops/pallas/window_attn.py:973
fused_window_attention`` (forward; body ``_kernel_body`` :173). On the card
the two projections are tensor-core GEMMs with a fused bias epilogue and the
attention core runs one block per (window, head) with the score strip, the
probabilities and the output tile in shared memory, so the (B*nW, nh, T, T)
scores never reach device memory. See the CUDA source for the bounds.

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
grid only fitted the TPU's VMEM at C = 512 / 1024.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from flair_for_aigle_tpu_torch.ops import _build
from flair_for_aigle_tpu_torch.ops._vjp import plain_vjp

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


def fused_window_attention_reference(x, wqkv, bqkv, wproj, bproj, bias, *,
                                     num_heads: int, window_size: int,
                                     shift_size: int, grid_hw,
                                     attn_f32: bool = True) -> torch.Tensor:
    """Plain version of the kernel, in the Pallas body's order of
    operations. x: (B*nW, T, C); bias: (nh, T, T). Returns (B*nW, T, C)."""
    bnw, t, c = x.shape
    nh = num_heads
    hd = c // nh
    dt = x.dtype
    scale = hd ** -0.5
    qkv = _linear(x.reshape(bnw * t, c), wqkv, bqkv)
    qkv = qkv.reshape(bnw, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                      # (bnw, nh, t, hd)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    mask = None
    if shift_size > 0:
        nwh, nww = grid_hw
        mask = torch.as_tensor(_grid_mask(window_size, shift_size, nwh, nww),
                               device=x.device)[:, None]  # (nW, 1, t, t)
    if attn_f32:
        s = s * scale + bias.float()
        if mask is not None:
            s = (s.reshape(-1, mask.shape[0], nh, t, t) + mask).reshape(
                bnw, nh, t, t)
        e = torch.exp(torch.clamp(s, max=CLAMP) - SHIFT)
        denom = e.sum(-1, keepdim=True) + 1e-37
    else:
        s = s.to(dt) * torch.tensor(scale, dtype=dt, device=x.device)
        s = s + bias.to(dt)
        if mask is not None:
            s = (s.reshape(-1, mask.shape[0], nh, t, t) + mask.to(dt)).reshape(
                bnw, nh, t, t)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        denom = (e.sum(-1, keepdim=True) + 1e-37).float()
    o = torch.matmul(e.to(dt).float(), v.float()) / denom
    o = o.to(dt).transpose(1, 2).reshape(bnw * t, c)
    return _linear(o, wproj, bproj).reshape(bnw, t, c)


def _check(x, num_heads: int, window_size: int, grid_hw, what: str) -> None:
    bnw, t, c = x.shape
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
    x's device, contiguous, shape-checked."""
    _, t, c = x.shape
    dt = x.dtype
    wqkv, bqkv, wproj, bproj = (p.detach().to(x.device, dt).contiguous()
                                for p in (wqkv, bqkv, wproj, bproj))
    bias = bias.detach().to(x.device, bias_dtype).contiguous()
    if (wqkv.shape != (3 * c, c) or bqkv.shape != (3 * c,)
            or wproj.shape != (c, c) or bproj.shape != (c,)
            or bias.shape != (nh, t, t)):
        raise ValueError(f"{what}: parameter shapes do not match x")
    return wqkv, bqkv, wproj, bproj, bias


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
    bnw, t, c = x.shape
    dt = x.dtype
    wqkv, bqkv, wproj, bproj, bias = _params(
        x, wqkv, bqkv, wproj, bproj, bias, num_heads,
        torch.float32 if attn_f32 else dt, what)
    nwh, nww = grid_hw
    qkv = torch.empty((bnw * t, 3 * c), dtype=dt, device=x.device)
    o = torch.empty((bnw * t, c), dtype=dt, device=x.device)
    out = torch.empty((bnw, t, c), dtype=dt, device=x.device)
    rc = _build.lib().window_attn_fwd(
        x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), bias.data_ptr(), qkv.data_ptr(), o.data_ptr(),
        out.data_ptr(), bnw, t, c, num_heads, window_size, shift_size, nwh,
        nww, int(bool(attn_f32)), _build.dtype_code(x), _build.stream_ptr(x))
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


def fused_window_attention_backward_reference(g, x, wqkv, bqkv, wproj, bproj,
                                              bias, **cfg) -> tuple:
    """Plain backward: autograd through the plain forward. Returns
    (dx, dwqkv, dbqkv, dwproj, dbproj, dbias) in the inputs' dtypes."""
    return plain_vjp(lambda *a: fused_window_attention_reference(*a, **cfg),
                     (x, wqkv, bqkv, wproj, bproj, bias), g)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _bwd_plan(bnw: int, nh: int, m: int, c: int, n_sm: int) -> tuple[int, int]:
    """(window groups of the core launch, k_chunk of the weight-gradient
    GEMMs): about two blocks per SM in each launch."""
    want = 2 * n_sm
    groups = min(bnw, max(1, _ceil(want, nh)))
    groups = _ceil(bnw, _ceil(bnw, groups))
    tiles = _ceil(c, 128) * _ceil(c, 64)
    n_split = max(1, min(_ceil(want, tiles), _ceil(m, 256)))
    return groups, _ceil(_ceil(m, n_split), 32) * 32


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
    g = g.to(dev, dt).contiguous()
    wq, bq, wp, _, b32 = _params(x, wqkv, bqkv, wproj, bproj, bias, nh,
                                 torch.float32, what)
    m = bnw * t
    groups, k_chunk = _bwd_plan(bnw, nh, m, c,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
    n_split = _ceil(m, k_chunk)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def cdt(*shape):
        return torch.empty(shape, dtype=dt, device=dev)

    qkv, do, o, dqkv = cdt(m, 3 * c), cdt(m, c), cdt(m, c), cdt(m, 3 * c)
    dbias_part, dbqkv_part = f32(groups, nh, t, t), f32(groups, 3 * c)
    wpart = f32(n_split * 3 * c * c)
    dx = cdt(bnw, t, c)
    dwqkv, dbqkv, dwproj, dbproj, dbias = (f32(3 * c, c), f32(3 * c), f32(c, c),
                                           f32(c), f32(nh, t, t))
    nwh, nww = grid_hw
    rc = _build.lib().window_attn_bwd(
        x.data_ptr(), g.data_ptr(), wq.data_ptr(), bq.data_ptr(), wp.data_ptr(),
        b32.data_ptr(), qkv.data_ptr(), do.data_ptr(), o.data_ptr(),
        dqkv.data_ptr(), dbias_part.data_ptr(), dbqkv_part.data_ptr(),
        wpart.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(),
        dwproj.data_ptr(), dbproj.data_ptr(), dbias.data_ptr(), bnw, t, c, nh,
        window_size, shift_size, nwh, nww, int(bool(attn_f32)), groups,
        k_chunk, _build.dtype_code(x), _build.stream_ptr(x))
    _build.check(rc, "window_attn_bwd")
    fused_window_attention_backward.launches += 1
    return (dx, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dbproj.to(bproj.dtype), dbias.to(bias.dtype))


fused_window_attention_backward.launches = 0
