"""K1's and K5's times at swin-base@512's stages: ``fused_ln_shift_partition``
(the prologue, at the four stages, window 12, shift 6) and
``fused_patch_merge`` (at the three merges), each beside its plain version
and a yardstick of one PyTorch call.

    python -m flair_for_aigle_tpu_torch.tools.time_prep_merge [--batch 2] [--dtype bfloat16|float32]

Prints the card's line (name and power limit from nvidia-smi), one JSON
line per stage ``{"op", "hw", "c", "ms", "plain_ms", "device_ms",
"plain_device_ms", "library_device_ms"}`` and a last line with the sums per
op. ``ms`` and ``plain_ms`` are CUDA events around each call
(``tools/timing.py cuda_ms``); the ``*device_ms`` keys are device time
(``device_ms``), with the host's work hidden, so ``ms - device_ms`` is what
the wrapper's host work adds to a call. The yardsticks, as device time:
``F.layer_norm`` over the same (B, H, W, C) input with the weights in its
dtype (K1 moves the bytes that call moves, plus the padded windows); the
reduction alone through cuBLAS, ``F.linear`` on the ready LN rows in the
same dtype, TF32 off (K5's GEMM part). It reads nothing of the two ops but
the wrappers and their plain versions, so an older checkout with this file
and ``tools/timing.py`` copied into its ``tools/`` times that checkout's
kernels the same way. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from flair_for_aigle_tpu_torch.ops import merge, prep
from flair_for_aigle_tpu_torch.tools.timing import cuda_ms, device_ms

STAGES = [(128, 128), (64, 256), (32, 512), (16, 1024)]  # (H = W, C)
MERGES = STAGES[:3]  # (H = W, C) entering each merge
WS, SS = 12, 6


def prep_times(x, s, b) -> dict:
    """K1 on x (B, H, W, C) with LayerNorm scale s and bias b (float32),
    window 12, shift 6, by both timings, and ``F.layer_norm`` on x with
    the weights in x's dtype as device time."""
    kw = dict(ws=WS, ss=SS)
    c = x.shape[-1]
    sd, bd = s.to(x.dtype), b.to(x.dtype)
    kernel = lambda: prep.fused_ln_shift_partition(x, s, b, **kw)  # noqa: E731
    plain = lambda: prep.fused_ln_shift_partition_reference(x, s, b, **kw)  # noqa: E731
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "library_device_ms": device_ms(lambda: F.layer_norm(x, (c,), sd, bd))}


def merge_times(x, s, b, w) -> dict:
    """K5 on x (B, H, W, C) with LayerNorm scale s, bias b (4C, float32)
    and the reduction w (2C, 4C), by both timings, and the reduction alone
    through cuBLAS (``F.linear`` on the plain version's LN rows in x's
    dtype, TF32 off for it, restored after) as device time."""
    bsz, h, wd, c = x.shape
    y = x.reshape(bsz, h // 2, 2, wd // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
    yf = y.reshape(-1, 4 * c).float()
    ln = F.layer_norm(yf, (4 * c,), s, b).to(x.dtype)
    wd_ = w.to(x.dtype)
    kernel = lambda: merge.fused_patch_merge(x, s, b, w)  # noqa: E731
    plain = lambda: merge.fused_patch_merge_reference(x, s, b, w)  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_l = device_ms(lambda: F.linear(ln, wd_))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain),
            "library_device_ms": t_l}


def inputs(op: str, batch: int, hw: int, c: int, dtype, randn) -> tuple:
    """The inputs of ``prep_times`` (op "prep") or ``merge_times`` ("merge")
    at one stage, from ``randn(*shape, std=..., dt=...)``."""
    x = randn(batch, hw, hw, c, dt=dtype)
    if op == "prep":
        return x, randn(c, std=0.1) + 1, randn(c, std=0.1)
    return (x, randn(4 * c, std=0.1) + 1, randn(4 * c, std=0.1),
            randn(2 * c, 4 * c, std=(4 * c) ** -0.5))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_prep_merge measures the card's time: no CUDA card here")
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
    for op, stages, times in (("prep", STAGES, prep_times), ("merge", MERGES, merge_times)):
        for hw, c in stages:
            line = times(*inputs(op, args.batch, hw, c, dtype, randn))
            print(json.dumps({"op": op, "hw": hw, "c": c, **line}), flush=True)
            for k, v in line.items():
                sums.setdefault(op, {})[k] = sums.get(op, {}).get(k, 0.0) + v
    print(json.dumps({"batch": args.batch, "dtype": args.dtype, "sum": sums}), flush=True)


if __name__ == "__main__":
    main()
