"""The window-attention products without softmax, per head and with the
heads grouped (CUDA kernels ``csrc/attn_dots.cu``), and their plain PyTorch
version: the kernels of the A/B tool ``flair_for_aigle_tpu_torch.tools.
exp_attn_dots``.

Replaces ``tools/exp_attn_dots.py`` (``build`` :79): ``body_a`` :44
(``attn_dots_per_head``) and ``body_b`` :57 (``attn_dots_grouped``). For
bf16 (BNW, T, C) q, k, v and each head h of width C / num_heads:
S = Q_h K_h^T accumulated in float32 and rounded to bf16 (no softmax), then
O_h = S V_h accumulated in float32 and rounded to bf16, written at the
head's channels of a bf16 (BNW, T, C) output. Both variants compute the
same function; they differ in what one block of the card loads and runs
(see the CUDA source). ``bw`` windows go to one block, as ``BW`` windows go
to one grid step of the TPU tool; BNW must be a multiple of ``bw`` (the TPU
tool's ``N_INST = BNW // BW`` leaves the remaining windows unwritten).
"""

from __future__ import annotations

import torch

from flair_for_aigle_tpu_torch.ops import _build

#: the kernels' window (T = 12 x 12 tokens), head dim and head-group width
T = 144
HEAD_DIM = 32
GROUP = 128


def attn_dots_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        num_heads: int) -> torch.Tensor:
    """Plain version: per-head ``torch.matmul`` in float32 (exact bf16
    products, float32 sums), the scores rounded to the input dtype, then
    P V in float32 rounded to the input dtype."""
    bnw, t, c = q.shape
    hd = c // num_heads

    def heads(x):
        return x.reshape(bnw, t, num_heads, hd).permute(0, 2, 1, 3).float()

    p = torch.matmul(heads(q), heads(k).transpose(-1, -2)).to(q.dtype)
    o = torch.matmul(p.float(), heads(v)).to(q.dtype)
    return o.permute(0, 2, 1, 3).reshape(bnw, t, c)


def _check(q, k, v, num_heads: int, bw: int, grouped: bool) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attn_dots: q, k, v must share one (BNW, T, C) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bnw, _, c = q.shape
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"attn_dots: C={c} is not a multiple of num_heads={num_heads}")
    if bw < 1 or bnw % bw:
        raise ValueError(f"attn_dots: BNW={bnw} windows is not a multiple of bw={bw}")
    hd = c // num_heads
    if grouped and (GROUP % hd or c % GROUP):
        raise ValueError(f"attn_dots grouped: needs head dim dividing {GROUP} and C % {GROUP} "
                         f"== 0, got head dim {hd}, C={c}")


def _launch(fn, q, k, v, num_heads: int, bw: int) -> torch.Tensor:
    """The named CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return attn_dots_reference(q, k, v, num_heads=num_heads)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"attn_dots kernel: q, k, v must lie on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if {q.dtype, k.dtype, v.dtype} != {torch.bfloat16}:
        raise ValueError(f"attn_dots kernel: takes bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attn_dots kernel: q, k, v must be contiguous")
    bnw, t, c = q.shape
    if t != T or c != HEAD_DIM * num_heads:
        raise ValueError(f"attn_dots kernel: takes T={T} and head dim {HEAD_DIM}, got T={t}, "
                         f"C={c}, num_heads={num_heads}")
    q, k, v = (_build.aligned(u) for u in (q, k, v))  # 16-byte cp.async copies
    out = torch.empty_like(q)
    name = fn.__name__
    rc = getattr(_build.lib(), name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                     bnw, t, c, num_heads, bw, _build.stream_ptr(q))
    _build.check(rc, name)
    fn.launches += 1
    return out


def attn_dots_per_head(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       num_heads: int, bw: int = 1) -> torch.Tensor:
    """(BNW, T, C) x3 -> (BNW, T, C), one head at a time (the TPU tool's
    ``body_a``); on the card one block per (``bw`` windows, head). CPU
    tensors take the plain version; CUDA tensors launch the kernel (bf16,
    contiguous, T = 144, head dim 32) or raise."""
    _check(q, k, v, num_heads, bw, grouped=False)
    return _launch(attn_dots_per_head, q, k, v, num_heads, bw)


def attn_dots_grouped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_heads: int, bw: int = 1) -> torch.Tensor:
    """The same function with the heads of each 128-channel group together
    (the TPU tool's ``body_b``); on the card one block per (``bw`` windows,
    head group). C must be a multiple of 128. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, num_heads, bw, grouped=True)
    return _launch(attn_dots_grouped, q, k, v, num_heads, bw)


attn_dots_per_head.launches = 0
attn_dots_grouped.launches = 0
