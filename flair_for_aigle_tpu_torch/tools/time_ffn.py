"""K3's times at swin-base@512's four stages: ``fused_ln_mlp_residual`` (the
kernel), its plain version, and its two products alone through cuBLAS
(``torch.nn.functional.linear`` twice in the same dtype, TF32 off), on N =
batch * H * W rows of C with hidden = 4 C; with ``--backward``, K7's
(``fused_ln_mlp_residual_backward``) the same way, beside its five products
alone through cuBLAS (``torch.matmul`` five times, same dtype, TF32 off).

    python -m flair_for_aigle_tpu_torch.tools.time_ffn [--batch 2] \
        [--dtype bfloat16|float32] [--backward]

Prints the card's line (name and power limit from nvidia-smi), one JSON
line per stage ``{"hw", "c", "n", "ms", "plain_ms", "device_ms",
"plain_device_ms", "cublas_device_ms"}`` and a last line with the sums
over the stages. ``ms`` and ``plain_ms`` are CUDA events around each call
(``tools/timing.py cuda_ms``), the times of ``chip_smoke.py``'s ``kernels``
line; the ``*device_ms`` keys are device time (``device_ms``), with the
host's work hidden. ``chip_smoke.py``'s K3 lines take their times from
``stage_times``, its K7 lines from ``backward_stage_times``. It reads
nothing of K3 and K7 but ``fused_ln_mlp_residual``,
``fused_ln_mlp_residual_backward`` and their plain versions, so an older
checkout with this file and ``tools/timing.py`` copied into its ``tools/``
times that checkout's K3 and K7 the same way. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.ops import ffn
from flair_for_aigle_tpu_torch.tools.timing import cuda_ms, device_ms

STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]  # (H = W, C)


def stage_times(x, a, p) -> dict:
    """K3 on rows x, attn a and parameters p (``fused_ln_mlp_residual``'s
    order) by both timings, and its two products alone through cuBLAS in
    x's dtype, TF32 off for them (restored after), as device time."""
    c = x.shape[-1]
    ln = x.reshape(-1, c)
    w1, w2 = p[2].to(x.dtype), p[4].to(x.dtype)
    h = F.linear(ln, w1)
    kernel = lambda: ffn.fused_ln_mlp_residual(x, a, *p)  # noqa: E731
    plain = lambda: ffn.fused_ln_mlp_residual_reference(x, a, *p)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: (F.linear(ln, w1), F.linear(h, w2)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "cublas_device_ms": t_l}


def backward_stage_times(x, a, gy, p) -> dict:
    """K7 on rows x, attn a, output gradient gy and parameters p
    (``fused_ln_mlp_residual``'s order; b2 unused) by both timings, its
    plain version as device time, and its five products alone through
    cuBLAS in x's dtype (fc1 ln W1^T, dh = g W2, dW2 = g^T h, dW1 = dh^T ln,
    dln = dh W1; ``torch.matmul``, TF32 off for them, restored after) as
    device time: a yardstick of the GEMM part, not a call computing K7's
    fused function."""
    c = x.shape[-1]
    s, b, w1, b1, w2 = p[:5]
    ln, g = x.reshape(-1, c), gy.reshape(-1, c)
    w1c, w2c = w1.to(x.dtype), w2.to(x.dtype)
    h = torch.matmul(ln, w1c.t())
    kernel = lambda: ffn.fused_ln_mlp_residual_backward(gy, x, a, s, b, w1, b1, w2)  # noqa: E731
    plain = lambda: ffn.fused_ln_mlp_residual_backward_reference(  # noqa: E731
        x, a, s, b, w1, b1, w2, gy)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: (torch.matmul(ln, w1c.t()), torch.matmul(g, w2c),
                                 torch.matmul(g.t(), h), torch.matmul(h.t(), ln),
                                 torch.matmul(h, w1c)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "cublas_device_ms": t_l}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--backward", action="store_true", help="time K7 in place of K3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_ffn measures the card's time: no CUDA card here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = getattr(torch, args.dtype)

    def randn(*shape, std=1.0, dt=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dt)

    sums: dict = {}
    for hw, c in STAGES:
        n = args.batch * hw * hw
        x, a = randn(n, c, dt=dtype), randn(n, c, std=0.5, dt=dtype)
        p = (randn(c) * 0.1 + 1, randn(c) * 0.1, randn(4 * c, c, std=c ** -0.5),
             randn(4 * c, std=0.02), randn(c, 4 * c, std=(4 * c) ** -0.5), randn(c, std=0.02))
        if args.backward:
            line = backward_stage_times(x, a, randn(n, c, dt=dtype), p)
        else:
            line = stage_times(x, a, p)
        print(json.dumps({"hw": hw, "c": c, "n": n, **line}), flush=True)
        for k, v in line.items():
            sums[k] = sums.get(k, 0.0) + v
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "backward": args.backward,
                      "sum": sums}), flush=True)


if __name__ == "__main__":
    main()
