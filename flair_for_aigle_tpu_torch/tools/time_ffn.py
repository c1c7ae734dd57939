"""K3's times at swin-base@512's four stages: ``fused_ln_mlp_residual`` (the
kernel), its plain version, and its two products alone through cuBLAS
(``torch.nn.functional.linear`` twice in the same dtype, TF32 off), on N =
batch * H * W rows of C with hidden = 4 C.

    python -m flair_for_aigle_tpu_torch.tools.time_ffn [--batch 2] [--dtype bfloat16|float32]

Prints the card's line (name and power limit from nvidia-smi), one JSON
line per stage ``{"hw", "c", "n", "ms", "plain_ms", "device_ms",
"plain_device_ms", "cublas_device_ms"}`` and a last line with the sums
over the stages. ``ms`` and ``plain_ms`` are CUDA events around each call
(``tools/timing.py cuda_ms``), the times of ``chip_smoke.py``'s ``kernels``
line; the ``*device_ms`` keys are device time (``device_ms``), with the
host's work hidden. ``chip_smoke.py``'s K3 lines take their times from
``stage_times``. It reads nothing of K3 but ``fused_ln_mlp_residual`` and
its plain version, so an older checkout with this file and
``tools/timing.py`` copied into its ``tools/`` times that checkout's K3 the
same way. Needs a card.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
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
        line = stage_times(x, a, p)
        print(json.dumps({"hw": hw, "c": c, "n": n, **line}), flush=True)
        for k, v in line.items():
            sums[k] = sums.get(k, 0.0) + v
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "sum": sums}), flush=True)


if __name__ == "__main__":
    main()
