"""K2's and K6's times at swin-base@512's four stages:
``fused_window_attention`` (K2) and its plain version, its two products
alone through cuBLAS (``torch.nn.functional.linear`` twice in the same
dtype, TF32 off), and with ``--backward`` ``fused_window_attention_backward``
(K6) and its plain version, on the shifted windows of ``--batch`` tiles of
512 px (window 12, shift 6, random weights from seed 0).

    python -m flair_for_aigle_tpu_torch.tools.time_window_attn [--batch 2] \\
        [--dtype bfloat16|float32] [--attn-f32 0|1] [--backward]

``--attn-f32`` defaults to the dtype's path: 0 for bf16 (the zonal
slice's), 1 for float32 (the training configuration's). Prints the card's
line (name and power limit from nvidia-smi), one JSON line per stage
``{"hw", "c", "bnw", "ms", "plain_ms", "device_ms", "plain_device_ms",
"cublas_device_ms"}`` (with ``--backward`` also ``bwd_ms``,
``bwd_plain_ms``, ``bwd_device_ms``, ``bwd_plain_device_ms`` and
``bwd_cublas_device_ms``, K6's four products alone through cuBLAS) and a
last line with the sums over the stages. ``ms`` keys are CUDA events around
each call (``tools/timing.py cuda_ms``), the times of ``chip_smoke.py``'s
``kernels`` line; ``*device_ms`` keys are device time (``device_ms``),
with the host's work hidden. ``chip_smoke.py``'s K2 lines take their times
from ``stage_times``. It reads nothing of K2 and K6 but the four public
functions, so an older checkout with this file and ``tools/timing.py``
copied into its ``tools/`` times its own K2 and K6 the same way. Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.ops import window_attn
from flair_for_aigle_tpu_torch.tools.timing import cuda_ms, device_ms

STAGES = [(128, 128, 4), (64, 256, 8), (32, 512, 16), (16, 1024, 32)]  # (H = W, C, heads)
WS, SS = 12, 6


def stage_times(win, params, akw) -> dict:
    """K2 on windows ``win`` (B*nW, T, C) and parameters ``params``
    (``fused_window_attention``'s order) by both timings, and its two
    products alone through cuBLAS in win's dtype, TF32 off for them
    (restored after), as device time."""
    bnw, t, c = win.shape
    dt = win.dtype
    x = win.reshape(bnw * t, c)
    wqkv, bqkv, wproj, bproj = (p.to(dt) for p in params[:4])
    o = x.clone()  # the core's output: (B*nW*T, C) in the compute dtype
    kernel = lambda: window_attn.fused_window_attention(win, *params, **akw)  # noqa: E731
    plain = lambda: window_attn.fused_window_attention_reference(win, *params, **akw)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: (F.linear(x, wqkv, bqkv), F.linear(o, wproj, bproj)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "cublas_device_ms": t_l}


def backward_times(gy, win, params, akw) -> dict:
    """K6 for the output gradient ``gy`` and its plain version (autograd
    through the plain forward) by both timings, and as a yardstick K6's
    four products alone through cuBLAS as device time: do = g Wproj,
    dWproj = g^T o, dWqkv = dqkv^T x and dx = dqkv Wqkv, ``torch.matmul``
    in win's dtype with TF32 off (restored after), on operands of their
    shapes (gy's and win's rows standing in for o and dqkv)."""
    kernel = lambda: window_attn.fused_window_attention_backward(gy, win, *params, **akw)  # noqa: E731
    plain = lambda: window_attn.fused_window_attention_backward_reference(  # noqa: E731
        gy, win, *params, **akw)
    bnw, t, c = win.shape
    x, g = win.reshape(bnw * t, c), gy.reshape(bnw * t, c)
    wqkv, wproj = params[0].to(win.dtype), params[2].to(win.dtype)
    o, dqkv = x, torch.cat([g, x, g], 1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: (torch.matmul(g, wproj), torch.matmul(g.t(), o),
                                 torch.matmul(dqkv.t(), x), torch.matmul(dqkv, wqkv)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"bwd_ms": cuda_ms(kernel), "bwd_plain_ms": cuda_ms(plain),
            "bwd_device_ms": device_ms(kernel), "bwd_plain_device_ms": device_ms(plain),
            "bwd_cublas_device_ms": t_l}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--attn-f32", type=int, choices=[0, 1], default=None)
    ap.add_argument("--backward", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_window_attn measures the card's time: no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)
    attn_f32 = (dtype == torch.float32) if args.attn_f32 is None else bool(args.attn_f32)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dt)

    sums: dict = {}
    for hw, c, nh in STAGES:
        nwh = -(-hw // WS)
        bnw = args.batch * nwh * nwh
        win = randn(bnw, WS * WS, c, dt=dtype)
        params = (randn(3 * c, c, std=c ** -0.5), randn(3 * c, std=0.02),
                  randn(c, c, std=c ** -0.5), randn(c, std=0.02),
                  randn(nh, WS * WS, WS * WS, std=0.02))
        akw = dict(num_heads=nh, window_size=WS, shift_size=SS, grid_hw=(nwh, nwh),
                   attn_f32=attn_f32)
        line = stage_times(win, params, akw)
        if args.backward:
            line.update(backward_times(randn(bnw, WS * WS, c, dt=dtype), win, params, akw))
        print(json.dumps({"hw": hw, "c": c, "bnw": bnw, **line}), flush=True)
        for k, v in line.items():
            sums[k] = sums.get(k, 0.0) + v
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "attn_f32": attn_f32,
                      "sum": sums}), flush=True)


if __name__ == "__main__":
    main()
